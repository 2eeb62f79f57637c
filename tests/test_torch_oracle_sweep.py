"""The port's oracle sweep against the JAX package's (`oracle_sweep`: the
chosen lam, every lam's mean PSNR, the predictions), for both priors and
per-sample kernels in chunks, and its refusals. Same seeded case and
float32 yardstick as `test_torch_oracle.py` (`tests/helpers/torch_oracle.py`).
"""
import numpy as np
import pytest
import torch

from kmsr_tpu.analysis import oracle as jo
from kmsr_tpu_torch.analysis import oracle as to
from tests.helpers.torch_oracle import (  # noqa: F401
    C, FACTOR, HW, ITERS, assert_close_or_f64 as _assert_close_or_f64,
    gauss_kernel as _gauss_kernel, make_lr as _lr, one_torch_thread,
    port_batch as _port_batch, scene as _scene, x8_case)


@pytest.mark.parametrize("prior", ["grad", "matched"])
def test_oracle_sweep_matches_jax(x8_case, prior):
    """N=3 5x64^2 at x8, 30 iterations: the same chosen lam, every lam's
    mean PSNR within 0.01 dB, the predictions at the tolerance."""
    hr, kernel, lr = x8_case
    extra = {}
    if prior == "matched":
        extra = {"noise_var": np.full(C, 4e-4), "spec_examples": _scene(4, HW, seed=5)}
    best_j, preds_j, res_j = jo.oracle_sweep(lr, hr, kernel, FACTOR, iters=ITERS,
                                             prior=prior, **extra)
    best_t, preds_t, res_t = to.oracle_sweep(lr, hr, kernel, FACTOR, iters=ITERS,
                                             prior=prior, device="cpu", **extra)
    assert best_t == best_j
    assert list(res_t) == list(res_j)
    for lam in res_j:
        assert abs(res_t[lam] - res_j[lam]) < 0.01, (lam, res_t[lam], res_j[lam])
    prior_args = (to.matched_prior(extra["spec_examples"], extra["noise_var"])
                  if extra else (None, None))
    # the returned predictions are the chosen lam's solve
    np.testing.assert_array_equal(preds_t, _port_batch(lr, kernel, best_t, *prior_args, False))
    f64 = _port_batch(lr, kernel, best_j, *prior_args, False, torch.float64)
    _assert_close_or_f64(preds_t, preds_j, f64, float(np.ptp(hr)))


def test_oracle_sweep_per_sample_chunks_match_jax(x8_case):
    """Per-sample kernels swept in chunks of 2 over N=3 (each chunk its
    own joint system, its own kernels): JAX's lam and PSNRs."""
    hr, _, _ = x8_case
    kernel = np.stack([_gauss_kernel(C, 13, s) for s in (1.5, 2.0, 2.5)])
    lr = _lr(hr, kernel, FACTOR, seed=4)
    lams = (1e-4, 1e-3, 1e-2)
    best_j, preds_j, res_j = jo.oracle_sweep(lr, hr, kernel, FACTOR, lams=lams,
                                             iters=ITERS, chunk=2)
    stops = {}
    best_t, preds_t, res_t = to.oracle_sweep(lr, hr, kernel, FACTOR, lams=lams, iters=ITERS,
                                             chunk=2, device="cpu", cg_iters=stops)
    assert best_t == best_j and list(stops) == list(lams)
    assert all(len(v) == 2 and all(0 < k <= ITERS for k in v) for v in stops.values())
    for lam in lams:
        assert abs(res_t[lam] - res_j[lam]) < 0.01, (lam, res_t[lam], res_j[lam])
    assert preds_t.shape == hr.shape and np.isfinite(preds_t).all()


def test_oracle_sweep_refuses_bad_priors_and_a_missing_card(x8_case):
    hr, kernel, lr = x8_case
    with pytest.raises(ValueError, match="needs noise_var"):
        to.oracle_sweep(lr, hr, kernel, FACTOR, prior="matched", device="cpu")
    with pytest.raises(ValueError, match="unknown prior"):
        to.oracle_sweep(lr, hr, kernel, FACTOR, prior="tv", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            to.oracle_sweep(lr, hr, kernel, FACTOR)
