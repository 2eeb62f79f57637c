"""Driver of the KernelGAN fleet: `kmsr_tpu_torch.train.fleet.
make_fleet_advance`, the step loop of `train_fleet`, on `scenes` scenes.

Set-up makes each scene's pools on the device from the seed (`hr_patches`
HR patches and `lr_patches` native-LR patches a scene), resolves
`fake_noise: auto` with the benchmark's own estimate of the LR pools' noise
(a Haar diagonal-detail MAD a band: the median over the first 64 patches of
each scene, then over scenes), makes every scene's weights (G's
Gaussian/identity/mean chain, D's fan-in uniform convs and unit u vectors)
and generator, and builds the stacked states, the chunk width and the
advance as `train_fleet` does. It then drives that advance through its
first call (K steps) and one more, which warm every shape; the first
call's metrics and the parameters it left are kept for the check.

The window calls the same advance, under the trainer's deterministic
algorithms, until `run.seconds` have passed, then synchronizes. The check
runs the plain reference (`reference.kernelgan`, in float64) from the same
weights, pools and seeds through the first call's K steps, scene by
scene, and compares D's loss and the gradient norms at the first step and
the parameters' change over the K steps (`compare`).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

import imagery
from harness import sub_seed
from reference import kernelgan as plain


def noise_sigma(lr_pools: torch.Tensor) -> torch.Tensor:
    """[bands] noise sigma of [S, N, bands, h, w] native-LR pools."""
    x = lr_pools[:, :64]
    hh = (x[..., ::2, ::2] - x[..., 1::2, ::2] - x[..., ::2, 1::2] + x[..., 1::2, 1::2]) / 2
    mad = hh.abs().flatten(3).median(dim=-1).values / 0.6745  # [S, n, bands]
    return mad.median(dim=1).values.median(dim=0).values


def _g_layers(tk: dict, bands: int, dev) -> list:
    """G's initial chain [bands, out, in, k, k] a layer: a Gaussian first
    layer, identities, a mean last layer: its composed kernel is the
    Gaussian."""
    ks, mid, sig = tk["g_kernel_sizes"], tk["g_mid_ch"], tk["g_init_sigma"]
    out = []
    for i, k in enumerate(ks):
        o = 1 if i == len(ks) - 1 else mid
        c = 1 if i == 0 else mid
        if i == 0:
            r = torch.arange(k, device=dev, dtype=torch.float32) - (k - 1) / 2
            g = torch.exp(-(r[:, None] ** 2 + r[None, :] ** 2) / (2 * sig ** 2))
            w = (g / g.sum()).expand(bands, o, c, k, k)
        elif i == len(ks) - 1:
            w = torch.full((bands, o, c, k, k), 1.0 / mid, device=dev)
        else:
            w = torch.zeros((o, c, k, k), device=dev)
            j = torch.arange(min(o, c), device=dev)
            w[j, j, k // 2, k // 2] = 1.0
            w = w.expand(bands, o, c, k, k)
        out.append(w.contiguous())
    return out


def _d_weights(run, tk: dict, bands: int, scenes: int) -> tuple[list, list]:
    """Each scene's D parameters and state, drawn on the device."""
    base, blocks, dev = tk["d_base_ch"], tk["d_blocks"], run.device
    shapes = [(base, bands, tk["d_first_kernel"])] + [(base, base, 1)] * blocks + [(1, base, 1)]
    per = sum(o * i * k * k + o for o, i, k in shapes)
    gen = run.generator("d_weights")
    flat = imagery.uniform(gen, (scenes, per), 1.0, dev)
    us = torch.randn((scenes, sum(o for o, _, _ in shapes)), generator=gen, device=dev)
    params, states = [], []
    for s in range(scenes):
        at, ua, convs, u = 0, 0, [], []
        for o, i, k in shapes:
            bound = 1.0 / (i * k * k) ** 0.5
            w = flat[s, at:at + o * i * k * k].reshape(o, i, k, k) * bound
            at += o * i * k * k
            convs.append({"w": w, "b": flat[s, at:at + o] * bound})
            at += o
            u0 = us[s, ua:ua + o]
            u.append(u0 / (torch.linalg.vector_norm(u0) + 1e-12))
            ua += o
        params.append({"convs": convs, "bn_scale": [torch.ones(base, device=dev)] * blocks,
                       "bn_bias": [torch.zeros(base, device=dev)] * blocks})
        states.append({"u": u, "bn_mean": [torch.zeros(base, device=dev)] * blocks,
                       "bn_var": [torch.ones(base, device=dev)] * blocks})
    return params, states


def _config(tk: dict, sigma: tuple, outdir: str):
    from kmsr_tpu_torch.models.discriminator import DiscriminatorConfig
    from kmsr_tpu_torch.models.generator import GeneratorConfig
    from kmsr_tpu_torch.train.single_kernel import SingleKernelConfig

    return SingleKernelConfig(
        iters=tk["iters"], hr_patch_size=tk["hr_patch_size"], lr_crop_size=tk["lr_crop_size"],
        batch_size=tk["batch_size"], lr_rate=tk["lr"], grad_clip_norm=tk["grad_clip"],
        real_is_lr=tk["real_is_lr"], raw_sum_reg=tk["raw_sum_reg"],
        fake_noise_sigma=sigma, reg_weights=dict(tk["reg_weights"]),
        steps_per_call=tk["steps_per_call"], seed=0, outdir=outdir, verbose=False,
        save_intermediate=False,
        generator=GeneratorConfig(in_ch=tk["bands"], mid_ch=tk["g_mid_ch"],
                                  ks=tuple(tk["g_kernel_sizes"]),
                                  gaussian_sigma=tk["g_init_sigma"], factor=tk["factor"],
                                  forward_mode="compose" if tk["fast_forward"] else "chain"),
        discriminator=DiscriminatorConfig(in_ch=tk["bands"], base_ch=tk["d_base_ch"],
                                          num_blocks=tk["d_blocks"]))


def _scene_params(chunks: list, m: int, s: int) -> list:
    """Scene s's parameters in the stacked states, in `plain.leaves` order
    (D's, then G's layers), as copies."""
    st = chunks[s // m]
    j = s % m
    return [t[j].detach().clone() for t in plain.leaves(st.d_params)] + \
        [t[j].detach().clone() for t in st.g_params["layers"]]


def setup(run) -> dict:
    from kmsr_tpu_torch.device import deterministic
    from kmsr_tpu_torch.train.fleet import _stack_states, make_fleet_advance, pick_scene_chunk
    from kmsr_tpu_torch.train.single_kernel import init_training

    tk, tr, dev = run.config["train_kernel"], run.traffic, run.device
    S, c = tr["scenes"], tk["bands"]
    hr_s, lr_s = tk["hr_patch_size"], tk["lr_crop_size"]
    hr = imagery.fields(run.generator("hr_pools"), S * tr["hr_patches"], c, hr_s, hr_s, dev)
    hr = hr.view(S, tr["hr_patches"], c, hr_s, hr_s)
    lr = imagery.fields(run.generator("lr_pools"), S * tr["lr_patches"], c, lr_s, lr_s, dev)
    lr = lr.view(S, tr["lr_patches"], c, lr_s, lr_s)
    sigma = noise_sigma(lr)
    run.note("pools made")
    cfg = _config(tk, tuple(float(x) for x in sigma.cpu()), str(run.tmp / "fleet"))
    g0 = _g_layers(tk, c, dev)
    d0, ds0 = _d_weights(run, tk, c, S)
    seeds = [sub_seed(run.seed, f"scene{s}") for s in range(S)]
    states = []
    for s in range(S):
        st = init_training(dataclasses.replace(cfg, seed=s), dev)
        with torch.no_grad():
            for dst, src in zip(st.g_params["layers"], g0):
                dst.copy_(src)
            for dst, src in zip(plain.leaves(st.d_params), plain.leaves(d0[s])):
                dst.copy_(src)
            for dst, src in zip(plain.leaves(st.d_state), plain.leaves(ds0[s])):
                dst.copy_(src)
        st.rng = torch.Generator(device=dev).manual_seed(seeds[s])
        states.append(st)
    m = pick_scene_chunk(cfg, S, hr_s)
    chunks = [_stack_states(states[i:i + m]) for i in range(0, S, m)]
    del states
    advance = make_fleet_advance(cfg, chunks, hr, lr, [tr["hr_patches"]] * S,
                                 [tr["lr_patches"]] * S, None)
    run.note(f"{S} scenes built, {len(chunks)} chunk(s) of {m}")
    with deterministic(dev):
        first = advance()
        after = [_scene_params(chunks, m, s) for s in range(S)]
        run.sync()
        run.note("first call")
        advance()
    run.sync()
    run.note("warm")
    return {"advance": advance, "m": m, "hr": hr, "lr": lr,
            "sigma": sigma, "g0": g0, "d0": d0, "ds0": ds0, "seeds": seeds,
            "first": first, "after": after}


def window(run, state) -> None:
    from kmsr_tpu_torch.device import deterministic

    tk, tr = run.config["train_kernel"], run.traffic
    per_call = tk["steps_per_call"] * tr["scenes"]
    advance = state["advance"]
    calls, traced, last = 0, None, state["first"]
    run.trace_start()  # before the window: starting the profiler takes seconds
    t0 = run.begin_window()
    deadline = t0 + run.seconds
    with deterministic(run.device):
        while (now := time.perf_counter()) < deadline:
            if traced is None and run.trace_t0 is not None and now >= run.trace_t0 + tr["trace_s"]:
                run.trace_stop()
                traced = calls
            last = advance()
            calls += 1
        run.sync()
    t1 = time.perf_counter()
    if run.trace_t0 is not None and traced is None:
        run.trace_stop()
        traced = calls
    run.window_s = t1 - t0
    run.attempted = calls * per_call
    finite = all(bool(torch.isfinite(ms["loss_D"]).all() and torch.isfinite(ms["loss_G_adv"]).all())
                 for ms in last)
    run.failed = 0 if finite else run.attempted
    run.counts.update(scene_its=calls * per_call,
                      traced_scene_its=(traced or 0) * per_call)


def compare(run, state, tf32: bool = False) -> dict:
    """The compared numbers of the first call, scene by scene, against the
    reference in float64: the largest relative gap of D's loss and of the
    gradient norms (D's, G's, before clipping) at the first step, before
    any update; and, over the K steps, the median over the parameter
    leaves of each leaf's gap in its change's norm, over the larger of the
    reference's norm and the median leaf's (a leaf whose first reference
    gradient is under a thousandth of the median leaf's left out).
    tf32=True puts the control (the reference in TF32) in the program's
    place."""
    tk, tr = run.config["train_kernel"], run.traffic
    S, m, K = tr["scenes"], state["m"], tk["steps_per_call"]
    cfg = {"batch_size": tk["batch_size"], "factor": tk["factor"], "lr": tk["lr"],
           "grad_clip": tk["grad_clip"], "raw_sum_reg": tk["raw_sum_reg"],
           "reg_weights": tk["reg_weights"]}
    worst = {"loss_D_rel": 0.0, "grad_norm_rel": 0.0, "change_rel": 0.0}
    dev = run.device

    def scene(s, **kw):
        return plain.Scene(state["g0"], state["d0"][s], state["ds0"][s], state["hr"][s],
                           state["lr"][s], torch.Generator(device=dev).manual_seed(state["seeds"][s]),
                           cfg, state["sigma"], **kw)

    for s in range(S):
        ref = scene(s, dtype=torch.float64)
        start = ref.params()
        rows = [ref.step() for _ in range(K)]
        if tf32:
            ctl = scene(s, tf32=True)
            got_rows = [ctl.step() for _ in range(K)]
            got_after = ctl.params()
        else:
            ms = state["first"][s // m]
            got_rows = [{k: ms[k][s % m, 0] for k in ("loss_D", "grad_norm_D", "grad_norm_G")}]
            got_after = state["after"][s]
        for key, keys in (("loss_D_rel", ("loss_D",)),
                          ("grad_norm_rel", ("grad_norm_D", "grad_norm_G"))):
            for k in keys:
                r, g = float(rows[0][k]), float(got_rows[0][k])
                worst[key] = max(worst[key], abs(g - r) / abs(r))
        gnorm = np.array([float(torch.linalg.vector_norm(g)) for g in rows[0]["grads"]])
        keep = gnorm >= 1e-3 * np.median(gnorm)
        ref_d = np.array([float(torch.linalg.vector_norm(a - b))
                          for a, b in zip(ref.params(), start)])
        got_d = np.array([float(torch.linalg.vector_norm(a.double() - b))
                          for a, b in zip(got_after, start)])
        scale = np.maximum(ref_d, np.median(ref_d[keep]))
        gap = (np.abs(got_d - ref_d) / scale)[keep]
        worst["change_rel"] = max(worst["change_rel"], float(np.median(gap)))
        del ref
    return worst


def verify(run, state) -> None:
    lim = run.traffic["limits"]
    got = compare(run, state)
    run.check("failed_scene_its", run.failed, 0)
    for k in ("loss_D_rel", "grad_norm_rel", "change_rel"):
        run.check(k, got[k], lim[k])


def control(run, state) -> dict:
    return compare(run, state, tf32=True)
