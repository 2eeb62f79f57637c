"""Single-kernel (static per-band) KernelGAN training, on one device or
data-parallel over ranks.

Counterpart of `kmsr_tpu.train.single_kernel`: unpaired LSGAN between
G(HR 256^2) -> fake 32^2 and independent real 32^2 crops, Adam (4e-4,
betas (0.5, 0.999)), global grad clip 20, kernel regularizer (alpha .5,
beta .5, gamma 5, delta 1, epsilon 3) at weight 0.002, the same CSV loss
log, kernel metrics / ASCII / intermediate kernel .npy dumps, and the
final kernel_per_band.npy [5,13,13] + kernel_merged.npy [13,13].

Each iteration is a D step, then a G step against the freshly updated D.
Batches come from the host exactly as in the JAX package: the host RNG
is `np.random.default_rng(seed + start_iter)` and draws `hr` before
`crop_src`, so both packages train on the same batches. The device draws
(random real crops, fake-side noise, the batch indices of K > 1 chunks)
come from a `torch.Generator` seeded with `seed` on the training device:
a different stream from the JAX package's `jax.random` keys, by design.

Metrics stay device tensors until the log flush: nothing in a step waits
for the device.

Data parallelism (`mesh=`, the CLI's `--data-parallel` under torchrun):
one process per card, every rank drawing the same global host batch and
keeping its rows (`parallel.mesh.shard_batch`); the step's random draws
are made at the global batch's shape and sliced, D's BatchNorm statistics
are the global batch's, the gradients are averaged over ranks before the
optimizer and the logged losses are the global batch's, so a DP run
follows the one-device run (bit for bit at world size 1). Rank 0 writes
the log, the kernels and the checkpoints.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..analysis.kernel_metrics import ascii_kernel, kernel_delta_l2, kernel_metrics
from ..data.sampler import PatchPool
from ..device import deterministic, resolve_device
from ..losses import lsgan_d_loss, lsgan_g_loss, per_band_kernel_regularization, scene_mean
from ..models.discriminator import (
    DiscriminatorConfig,
    discriminator_forward,
    init_discriminator,
)
from ..models.generator import (
    GeneratorConfig,
    extract_kernels,
    extract_kernels_raw,
    fold_scenes,
    generator_forward,
    init_generator,
)
from ..ops.degrade import fp32_convs
from ..parallel.mesh import (
    data_parallel,
    global_rows,
    local_rows,
    mesh_device,
    metrics_mean,
    reduce_grads,
    replicate_state,
    shard_batch,
)
from ..utils.profiling import stage_timer
from .graphed import graphed_step
from .state import (
    GANTrainState,
    check_mesh_vs_scan,
    check_scan_intervals,
    init_gan_state,
    make_chunk_step,
    make_gan_optimizers,
    maybe_resume,
    save_checkpoint,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

LOG_HEADER = "Iteration,Loss_D,Loss_G_adv,Loss_Reg,Loss_Reg_weighted\n"
_LOG_KEYS = ("loss_D", "loss_G_adv", "loss_reg", "loss_reg_weighted")
#: the metrics a K-step chunk stacks over its steps
_CHUNK_KEYS = _LOG_KEYS + ("grad_norm_D", "grad_norm_G", "kernels")


def _format_rows(rows: list, keys: tuple = _LOG_KEYS) -> list[str]:
    """[(first_iter, device metrics)] -> CSV lines; metrics may be per-step
    scalars or K-stacked chunk outputs. One host sync for all rows."""
    if not rows:
        return []
    counts = [torch.atleast_1d(m[keys[0]]).shape[0] for _, m in rows]
    cols = torch.stack([
        torch.cat([torch.atleast_1d(m[k]).detach() for _, m in rows])
        for k in keys]).cpu().numpy()
    out, j = [], 0
    for (i0, _), n in zip(rows, counts):
        for r in range(n):
            out.append(f"{i0 + r}," + ",".join(f"{c:.6f}" for c in cols[:, j]) + "\n")
            j += 1
    return out


@dataclasses.dataclass
class SingleKernelConfig:
    iters: int = 10_000
    hr_patch_size: int = 256
    lr_crop_size: int = 32
    batch_size: int = 16
    lr_rate: float = 4e-4
    reg_weight: float = 0.002
    grad_clip_norm: float = 20.0
    log_every: int = 100
    kernel_log_every: int = 100
    save_intermediate: bool = True
    differentiable_reg: bool = False  # reference quirk: reg has no G-gradient
    real_is_lr: bool = False  # crop_src is already real LR at lr_crop_size
    raw_sum_reg: float = 0.0  # weight of mean_b (sum(raw_kernel_b) - 1)^2 on
    #   the UN-clamped composed kernel (the clamped extraction zeroes the
    #   gradient of negative entries); 0 = reference behavior
    d_border_crop: int = 0  # crop this many pixels off every side of BOTH
    #   D inputs (the fake side's reflect-padding rim); 0 = reference
    d_lr_rate: Optional[float] = None  # D's Adam lr; None (or 0.0) = lr_rate
    fake_noise_learnable: bool = False  # learn the fake-side sigma per band
    #   (g_params["log_sigma"], exp + clip [1e-4, 4]), initialized from
    #   fake_noise_sigma
    fake_noise_sigma: Optional[tuple] = None  # per-band sigmas added to the
    #   FAKE side (G(HR) + N(0, sigma)), a fresh draw per D / G sub-step;
    #   None = off
    reg_weights: dict = dataclasses.field(
        default_factory=lambda: dict(alpha=0.5, beta=0.5, gamma=5.0, delta=1.0, epsilon=3.0)
    )
    generator: GeneratorConfig = dataclasses.field(default_factory=GeneratorConfig)
    discriminator: DiscriminatorConfig = dataclasses.field(
        default_factory=DiscriminatorConfig
    )
    outdir: str = "output/kernelgan_single"
    ckpt_every: int = 0  # 0 = no checkpoints
    resume: bool = False  # resume from the latest checkpoint in outdir/ckpt
    device_pool: Optional[bool] = None  # keep the whole patch pool on the
    #   device and gather batches there (no per-iter batch upload).
    #   None = auto: on for in-memory pools <= 4 GB without an lr_pool.
    steps_per_call: int = 1  # >1: K steps per call, batch indices drawn on
    #   the device (no host round trip). Requires device_pool; iters,
    #   log_every, kernel_log_every and ckpt_every must be multiples of K.
    #   K=1 keeps the reference's host-RNG sampling stream exactly.
    seed: int = 0
    verbose: bool = True


def random_crops(gen: torch.Generator, src: torch.Tensor, crop: int) -> torch.Tensor:
    """Per-sample random crops on src's device, one gather.
    src: [B, C, H, W] -> [B, C, crop, crop]."""
    b, c, h, w = src.shape
    dev = src.device
    n = global_rows(b)  # a DP step draws the global batch's offsets
    ys = local_rows(torch.randint(0, h - crop + 1, (n,), generator=gen, device=dev))
    xs = local_rows(torch.randint(0, w - crop + 1, (n,), generator=gen, device=dev))
    win = torch.arange(crop, device=dev)
    rows = (ys[:, None] + win)[:, None, :, None]
    cols = (xs[:, None] + win)[:, None, None, :]
    return src[torch.arange(b, device=dev)[:, None, None, None],
               torch.arange(c, device=dev)[None, :, None, None], rows, cols]


def _normal(gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """A standard normal draw shaped like `like` (the fake-side noise); a
    DP step draws the global batch's and keeps its rows."""
    shape = (global_rows(like.shape[0]), *like.shape[1:])
    return local_rows(torch.randn(shape, generator=gen, device=like.device,
                                  dtype=like.dtype))


def _optimizers(cfg: SingleKernelConfig) -> tuple:
    """(G's, D's) clipped Adam."""
    return (make_gan_optimizers(cfg.lr_rate, grad_clip_norm=cfg.grad_clip_norm),
            make_gan_optimizers(cfg.d_lr_rate or cfg.lr_rate,
                                grad_clip_norm=cfg.grad_clip_norm))


def _gan_step(cfg: SingleKernelConfig, scenes: Optional[int]) -> Callable:
    """The combined D+G step: step(state, hr, crop_src) -> (state, metrics),
    of one scene (`scenes=None`) or of m = `scenes` scenes stacked on the
    state's leading axis.

    Updates `state` in place and returns it. The fake batch is generated
    once: the D step sees it detached (plus its own noise draw), the G step
    reuses its graph with a second noise draw, which is what the JAX step's
    recomputation gives (same params, same hr). Besides the JAX package's
    metrics, "grads_D" / "grads_G" hold the gradients before clipping, in
    the parameters' layout.

    Stacked, the scenes fold into the channels of one generator pass
    (`models.generator.fold_scenes`) and of each discriminator pass
    (`discriminator_forward(scenes=m)`); the losses are per scene and
    summed for the gradients (the scenes are independent, so each scene's
    gradient is its own); each optimizer clips each scene by its own norm
    (`ClippedAdam.step(scenes=m)`); every draw comes from the scene's own
    generator in the one-scene order (real crop offsets, D's noise, G's
    noise). The layout's pieces below are chosen once, here.

    Each phase is a `utils.profiling.stage_timer` span with the step count
    as its item: `kernelgan.g_forward` (real crops, G, D's fake noise),
    `kernelgan.d_forward` (D's two passes and its loss),
    `kernelgan.d_backward`, `kernelgan.d_update`, `kernelgan.g_loss` (G's
    noise, D on the fake, adv, reg, raw-sum), `kernelgan.g_backward`,
    `kernelgan.g_update`.

    A fourth argument, {"g": ..., "d": ...}, gives each optimizer's bias
    corrections as device scalars (`ClippedAdam.step`'s `corrections`), as
    a CUDA graph's capture does (`train.graphed`).
    """
    g_tx, d_tx = _optimizers(cfg)
    bc, crop = cfg.d_border_crop, cfg.lr_crop_size
    noise_on = cfg.fake_noise_sigma is not None
    fixed_sigma: dict = {}  # device -> [1, C (m*C stacked), 1, 1], uploaded once

    if scenes is None:  # the identity and the state's one generator
        def fold(x):
            return x

        def real_crops(gen, src):
            return random_crops(gen, src, crop)

        def noise(gen, fake):
            return _normal(gen, fake)

        g_view = by_scene = total_of = fold
        raw_mean = torch.mean
    else:
        def fold(x):  # [m, B, C, H, W] -> [B, m*C, H, W], scene-major
            return x.transpose(0, 1).flatten(1, 2)

        def real_crops(gens, src):
            return fold(torch.stack([random_crops(g, src[s], crop) for s, g in enumerate(gens)]))

        def noise(gens, fake):
            like = fake[:, : fake.shape[1] // scenes]
            return torch.cat([_normal(g, like) for g in gens], dim=1)

        def by_scene(ks):  # [m*C, kH, kW] -> [m, C, kH, kW]
            return ks.unflatten(0, (scenes, -1))

        def raw_mean(x):
            return scene_mean(x, scenes, dim=0)

        g_view, total_of = fold_scenes, torch.sum

    def _trim(x):
        return x[..., bc:-bc, bc:-bc] if bc else x

    def _sigma_of(g_fold, dev):
        if cfg.fake_noise_learnable:
            return torch.clamp(torch.exp(g_fold["log_sigma"]), 1e-4, 4.0)[None, :, None, None]
        if dev not in fixed_sigma:
            fixed_sigma[dev] = torch.tensor(tuple(cfg.fake_noise_sigma) * (scenes or 1),
                                            dtype=torch.float32, device=dev)[None, :, None, None]
        return fixed_sigma[dev]

    def _noisy(fake, gens, g_fold):  # one draw from each scene's generator
        if not noise_on:
            return fake
        return fake + noise(gens, fake) * _sigma_of(g_fold, fake.device)

    # the backward convs too: autograd runs them after the forward
    # functions' own fp32 scopes have closed (TF32 is cuDNN's default)
    @fp32_convs()
    def step(state: GANTrainState, hr: torch.Tensor, crop_src: torch.Tensor,
             corrections: Optional[dict] = None):
        corrections = corrections or {}
        g_params, d_params, gens, t = state.g_params, state.d_params, state.rng, state.step
        with stage_timer("kernelgan.g_forward", item=t):
            real = fold(crop_src) if cfg.real_is_lr else real_crops(gens, crop_src)
            g_fold = g_view(g_params)
            fake = generator_forward(g_fold, fold(hr), factor=cfg.generator.factor,
                                     forward_mode=cfg.generator.forward_mode)
            fake_d = _noisy(fake, gens, g_fold)

        # ---- D step -------------------------------------------------------
        d_leaves = tree_leaves(d_params)
        with stage_timer("kernelgan.d_forward", item=t):
            pred_real, st = discriminator_forward(d_params, state.d_state, _trim(real),
                                                  train=True, scenes=scenes)
            pred_fake, st = discriminator_forward(d_params, st, _trim(fake_d.detach()),
                                                  train=True, scenes=scenes)
            loss_d = lsgan_d_loss(pred_real, pred_fake, scenes=scenes)
        with stage_timer("kernelgan.d_backward", item=t):
            d_grads = reduce_grads(torch.autograd.grad(total_of(loss_d), d_leaves))
        with stage_timer("kernelgan.d_update", item=t):
            d_grad_norm = d_tx.step(d_params, d_grads, state.d_opt_state, scenes=scenes,
                                    corrections=corrections.get("d"))

        # ---- G step (against the freshly updated D, reference order) -------
        with stage_timer("kernelgan.g_loss", item=t):
            # G's noise draw follows D's update, as the reference's
            fake_g = _noisy(fake, gens, g_fold)
            pred_fake, d_state = discriminator_forward(d_params, st, _trim(fake_g),
                                                       train=True, scenes=scenes)
            adv = lsgan_g_loss(pred_fake, scenes=scenes)
            ks = by_scene(extract_kernels(g_fold, differentiable=cfg.differentiable_reg))
            reg = per_band_kernel_regularization(ks, cfg.reg_weights)
            total = adv + cfg.reg_weight * reg
            if cfg.raw_sum_reg:
                raw_sums = extract_kernels_raw(g_fold).sum(dim=(1, 2))
                total = total + cfg.raw_sum_reg * raw_mean((raw_sums - 1.0) ** 2)
        g_leaves = tree_leaves(g_params)
        with stage_timer("kernelgan.g_backward", item=t):
            g_grads = reduce_grads([g if g is not None else torch.zeros_like(p) for g, p in zip(
                torch.autograd.grad(total_of(total), g_leaves, allow_unused=True), g_leaves)])
        with stage_timer("kernelgan.g_update", item=t):
            g_grad_norm = g_tx.step(g_params, g_grads, state.g_opt_state, scenes=scenes,
                                    corrections=corrections.get("g"))

        state.step += 1
        state.d_state = d_state
        metrics = {
            "loss_D": loss_d.detach(),
            "loss_G_adv": adv.detach(),
            "loss_reg": reg.detach(),
            "loss_reg_weighted": (cfg.reg_weight * reg).detach(),
            "grad_norm_D": d_grad_norm,
            "grad_norm_G": g_grad_norm,
            "kernels": ks.detach(),  # [C, kH, kW]; stacked [m, C, kH, kW]
            "grads_D": tree_unflatten(d_params, d_grads),
            "grads_G": tree_unflatten(g_params, g_grads),
        }
        return state, metrics_mean(metrics, ("loss_D", "loss_G_adv"))

    return step


def make_base_step(cfg: SingleKernelConfig) -> Callable:
    """The combined D+G step of one scene: step(state, hr, crop_src[,
    corrections]) -> (state, metrics) (`_gan_step` at `scenes=None`)."""
    return _gan_step(cfg, None)


def _scene_view(state: GANTrainState) -> GANTrainState:
    """The one scene of a one-scene stacked state as a plain state of
    views: the optimizer's in-place updates through it reach the stacked
    tensors."""
    def view(tree):
        return tree_map(lambda t: t[0], tree)

    return GANTrainState(state.step, view(state.g_params), view(state.d_params),
                         view(state.d_state), view(state.g_opt_state),
                         view(state.d_opt_state), state.rng[0])


def make_scenes_step(cfg: SingleKernelConfig, scenes: int) -> Callable:
    """The combined step over m = `scenes` scenes stacked in one state, the
    JAX fleet's vmap of it: `_gan_step` at `scenes=m`, step(state, hr,
    crop_src) -> (state, metrics). Every state tensor, hr [m, B, C, H, W]
    and crop_src [m, B, C, h, w] carry the scenes on their leading axis;
    `state.rng` is the list of the scenes' generators. Metrics are per
    scene: [m], kernels [m, C, K, K], the gradients in the stacked layout.
    Values equal the scenes' standalone steps to float32 reduction order.

    At m = 1 the step is `make_base_step` on the scene's views of the
    state, bit for bit: a batched matmul or a reduction over a scene axis
    may round otherwise.

    On a CUDA device outside a mesh and with a constant learning rate, the
    step replays as a CUDA graph captured once per stacked state
    (`train.graphed.graphed_step`: the same kernels on the same data, one
    host call a step; the phase spans fire only at the capture); elsewhere
    it runs eagerly. `.eager` is the step without the graph.
    """
    if scenes > 1:
        return graphed_step(_gan_step(cfg, scenes), _optimizers(cfg), scenes)
    base = make_base_step(cfg)

    def one_scene(state: GANTrainState, hr: torch.Tensor, crop_src: torch.Tensor,
                  corrections: Optional[dict] = None):
        view, metrics = base(_scene_view(state), hr[0], crop_src[0], corrections)
        state.step, state.d_state = view.step, tree_map(lambda t: t[None], view.d_state)
        state.g_opt_state["count"] = view.g_opt_state["count"]
        state.d_opt_state["count"] = view.d_opt_state["count"]
        return state, tree_map(lambda t: t[None], metrics)

    return graphed_step(one_scene, _optimizers(cfg), 1)


def make_train_step(cfg: SingleKernelConfig, device_pool: bool = False) -> Callable:
    """The combined D+G train step.

    step(state, hr_batch, crop_src_batch) -> (state, metrics), or with
    `device_pool=True`: step(state, pool_dev, hr_idx, crop_idx), the batch
    gathered on the device from a device-resident pool; with
    steps_per_call K > 1 as well: chunk(state, pool_dev), K steps with the
    indices drawn on the device.
    """
    step = make_base_step(cfg)

    if device_pool and cfg.steps_per_call > 1:
        return make_chunk_step(step, cfg.batch_size, cfg.steps_per_call, _CHUNK_KEYS)

    if device_pool:

        def pool_step(state, pool_dev, hr_idx, crop_idx):
            return step(state, pool_dev[hr_idx], pool_dev[crop_idx])

        return pool_step

    return step


def init_training(cfg: SingleKernelConfig, device: str | torch.device = "cuda") -> GANTrainState:
    """The initial train state on `device`: the deterministic G init, D
    drawn from `cfg.seed`, zeroed Adam moments, the device generator."""
    dev = resolve_device(device)
    g_params = init_generator(cfg.generator, device=dev)
    if cfg.fake_noise_learnable:
        if cfg.fake_noise_sigma is None:
            raise ValueError(
                "fake_noise_learnable needs fake_noise_sigma as the init "
                "(e.g. the wavelet-MAD estimate of the LR pool)"
            )
        g_params["log_sigma"] = torch.log(
            torch.tensor(cfg.fake_noise_sigma, dtype=torch.float32)).to(dev)
    d_params, d_state = init_discriminator(cfg.discriminator, seed=cfg.seed, device=dev)
    tx = make_gan_optimizers(cfg.lr_rate, grad_clip_norm=cfg.grad_clip_norm)
    rng = torch.Generator(device=dev).manual_seed(cfg.seed)
    return init_gan_state(rng, g_params, d_params, d_state, tx, tx)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev` without waiting for the device: on a card
    through pinned memory and a non-blocking copy (a pageable `.to()`
    synchronizes the stream)."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def make_batch_source(cfg: SingleKernelConfig, pool, lr_pool, use_device_pool: bool,
                      host_rng: np.random.Generator, dev: torch.device,
                      mesh=None) -> Callable:
    """draw() -> the arguments after `state` of one call of the
    `make_train_step(cfg, use_device_pool)` step: the host batches, or
    the device pool and the host's index draws (the same stream as
    `pool.sample`), or, for K > 1, the device pool alone. Under a mesh,
    this rank's rows of the global host batches."""
    if not use_device_pool:
        real_src = lr_pool if lr_pool is not None else pool
        if mesh is not None:
            def put(a):
                return shard_batch(mesh, a)
        else:
            def put(a):
                return _to_device(a, dev)

        def draw():
            hr = put(pool.sample(host_rng, cfg.batch_size))
            return hr, put(real_src.sample(host_rng, cfg.batch_size))

        return draw
    pool_dev = torch.from_numpy(pool.patches).to(dev)
    if cfg.steps_per_call > 1:
        return lambda: (pool_dev,)
    n_pool = len(pool)

    def draw_idx():
        hr_idx = host_rng.integers(0, n_pool, size=cfg.batch_size)
        crop_idx = host_rng.integers(0, n_pool, size=cfg.batch_size)
        return pool_dev, _to_device(hr_idx, dev), _to_device(crop_idx, dev)

    return draw_idx


def train_single_kernel(
    pool: PatchPool,
    cfg: SingleKernelConfig = SingleKernelConfig(),
    progress: bool = True,
    lr_pool: PatchPool | None = None,
    device: str | torch.device = "cuda",
    mesh=None,
) -> dict:
    """Run the full single-kernel KernelGAN loop over a patch pool.

    lr_pool optionally supplies the real-LR side from a SEPARATE pool
    (with cfg.real_is_lr, its patches are used as-is at lr_crop_size;
    without it, random crops are taken from it instead of from `pool`).

    Returns {"kernel_per_band": [C,13,13], "kernel_merged": [13,13],
    "state": final GANTrainState, "log_file": path}. On a CUDA device the steps run under `device.deterministic`, so a
    run is reproducible (CUBLAS_WORKSPACE_CONFIG must be set before the
    process first uses cuBLAS; the training CLIs set it).

    mesh: an optional `parallel.mesh.Mesh` ('data' axis): the batch is
    split over its ranks (module docstring); cfg.batch_size is the global
    batch and must divide by the mesh size. Incompatible with the device
    pool and K > 1 (`check_mesh_vs_scan`).
    """
    dev = mesh_device(device, mesh)
    main = mesh is None or mesh.is_main
    if cfg.real_is_lr:
        if lr_pool is None:
            raise ValueError(
                "real_is_lr=True needs lr_pool (a pool of native-LR patches "
                f"at lr_crop_size={cfg.lr_crop_size}); without it the 'real' "
                "side would be full HR patches from `pool`"
            )
        if lr_pool.shape[-1] != cfg.lr_crop_size:
            raise ValueError(
                f"real_is_lr=True needs lr_pool patches at lr_crop_size="
                f"{cfg.lr_crop_size}, got {lr_pool.shape[-1]}"
            )
    if lr_pool is not None and (cfg.device_pool or cfg.steps_per_call > 1):
        raise ValueError(
            "lr_pool mode samples on host; incompatible with device_pool / "
            "steps_per_call > 1"
        )
    check_mesh_vs_scan(cfg, mesh)
    use_device_pool = cfg.device_pool
    if use_device_pool is None:
        use_device_pool = (
            mesh is None
            and lr_pool is None
            and hasattr(pool, "patches")
            and pool.patches.nbytes <= 4 << 30
        )
    if use_device_pool and not hasattr(pool, "patches"):
        raise ValueError("device_pool needs an in-memory PatchPool")
    K = cfg.steps_per_call
    check_scan_intervals(
        cfg,
        {"iters": cfg.iters, "log_every": cfg.log_every,
         "kernel_log_every": cfg.kernel_log_every,
         "ckpt_every": cfg.ckpt_every},
        use_device_pool,
    )

    os.makedirs(cfg.outdir, exist_ok=True)
    log_file = os.path.join(cfg.outdir, "training_log.txt")
    step_fn = make_train_step(cfg, device_pool=use_device_pool)
    state = init_training(cfg, dev)
    ckpt_dir = os.path.join(cfg.outdir, "ckpt")
    state, start_iter = maybe_resume(cfg, state, ckpt_dir,
                                     announce=cfg.verbose and main)
    if mesh is not None:
        replicate_state(mesh, state)
    if start_iter == 0 and main:
        with open(log_file, "w", encoding="utf-8") as f:
            f.write(LOG_HEADER)

    host_rng = np.random.default_rng(cfg.seed + start_iter)
    draw = make_batch_source(cfg, pool, lr_pool, use_device_pool, host_rng, dev, mesh)
    prev_k = None
    log_rows: list = []
    if K > 1:
        # t iterates over the LAST iteration index of each K-step chunk
        iterator = range(start_iter + K - 1, cfg.iters, K)
    else:
        iterator = range(start_iter, cfg.iters)
    if progress and main:
        try:
            from tqdm import tqdm

            iterator = tqdm(iterator, desc="Training", unit="chunk" if K > 1 else "iter")
        except ImportError:
            pass

    with deterministic(dev), data_parallel(mesh):
        for t in iterator:
            state, metrics = step_fn(state, *draw())
            if K > 1:
                log_rows.append((t + 2 - K, metrics))
                metrics = {k: metrics[k][-1] for k in _CHUNK_KEYS}
            else:
                # device scalars, materialized only at the flush
                log_rows.append((t + 1, {k: metrics[k] for k in _LOG_KEYS}))

            if (t + 1) % cfg.log_every == 0:
                if main:
                    with open(log_file, "a", encoding="utf-8") as f:
                        f.writelines(_format_rows(log_rows))
                log_rows.clear()
                if progress and hasattr(iterator, "set_postfix"):
                    iterator.set_postfix(
                        D=f"{float(metrics['loss_D']):.4f}",
                        G_adv=f"{float(metrics['loss_G_adv']):.4f}",
                        RegW=f"{float(metrics['loss_reg_weighted']):.4f}",
                        gN_D=f"{float(metrics['grad_norm_D']):.2f}",
                        gN_G=f"{float(metrics['grad_norm_G']):.2f}",
                    )

            if (t + 1) % cfg.kernel_log_every == 0 and main:
                ks = metrics["kernels"].cpu().numpy()  # [C,kH,kW]
                k_merged = ks.mean(axis=0)
                km = kernel_metrics(k_merged)
                delta = kernel_delta_l2(k_merged, prev_k)
                prev_k = k_merged.copy()
                if cfg.verbose:
                    print(
                        f"  [Kernel] shape={km['k_shape']} sum={km['k_sum']:.4f} "
                        f"max={km['k_max']:.4f} std={km['k_std']:.4f} "
                        f"sparsity={km['sparsity']:.3f} "
                        f"center_offset={km['center_offset']:.3f} delta_L2={delta:.5f}"
                    )
                    print("  [Kernel ASCII merged]\n" + ascii_kernel(k_merged))
                if cfg.save_intermediate:
                    np.save(os.path.join(cfg.outdir, f"kernel_iter{t + 1}.npy"), k_merged)
                    np.save(
                        os.path.join(cfg.outdir, f"kernel_per_band_iter{t + 1}.npy"), ks
                    )

            if cfg.ckpt_every and (t + 1) % cfg.ckpt_every == 0 and main:
                save_checkpoint(ckpt_dir, state, t + 1)

    if log_rows and main:
        with open(log_file, "a", encoding="utf-8") as f:
            f.writelines(_format_rows(log_rows))

    ks_final = extract_kernels(state.g_params).cpu().numpy()
    k_merged = ks_final.mean(axis=0)
    if main:
        np.save(os.path.join(cfg.outdir, "kernel_per_band.npy"), ks_final)
        np.save(os.path.join(cfg.outdir, "kernel_merged.npy"), k_merged)
    return {
        "kernel_per_band": ks_final,
        "kernel_merged": k_merged,
        "state": state,
        "log_file": log_file,
    }
