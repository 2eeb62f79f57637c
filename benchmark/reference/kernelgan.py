"""Plain KernelGAN training step of one scene, float32 with TF32 off.

The step of `configs/quality_x8_real_lr.json`'s `train_kernel` block
(KernelGAN, arXiv:1909.06581, as the pipeline trains it): the generator is
a per-band linear conv chain, applied as its composed kernel (its impulse
response) on the reflect-padded HR batch, then an x`factor` block mean;
the real side is the scene's native LR patches; the fake side gets a fresh
Gaussian draw of a fixed per-band sigma for D's step and another for G's.
D is a 7x7 conv, LeakyReLU(0.2), blocks of 1x1 conv + BatchNorm +
LeakyReLU, and a 1x1 conv, each conv spectrally normalised by one power
step. One step: D on real and on the detached fake, the LSGAN D loss,
clipped Adam on D; then G against the updated D, the LSGAN G loss plus
`raw_sum_reg` times the mean over bands of (sum of the raw composed kernel
- 1)^2, clipped Adam on G. The kernel regulariser is reported (its value
at the extracted, clamped and normalised kernel) and has no gradient.

Each scene draws from its own `torch.Generator`: the HR and the LR batch
indices, then D's noise, then G's, in that order every step.

`tf32=True` is the control: the operands of every conv and matmul rounded
to TF32 (a straight-through rounding, so the gradients flow), one precision
step below the configuration's float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .degrade import round_tf32

_EPS = 1e-12


class _Prec:
    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __call__(self, x):
        return x + (round_tf32(x) - x).detach() if self.tf32 else x


def composed_kernels(layers: list, q) -> torch.Tensor:
    """[bands, K, K] raw composed kernels of the per-band chains (layers
    [bands, out, in, k, k]): each chain's response to a unit impulse under
    zero padding, flipped (a chain of cross-correlations is the
    cross-correlation with this kernel)."""
    span = sum(w.shape[-1] for w in layers) - len(layers) + 1
    size, c = 2 * span - 1, span - 1
    out = []
    for b in range(layers[0].shape[0]):
        x = torch.zeros((1, 1, size, size), device=layers[0].device, dtype=layers[0].dtype)
        x[0, 0, c, c] = 1.0
        for w in layers:
            x = F.conv2d(q(x), q(w[b]), padding=w.shape[-1] // 2)
        r = span // 2
        out.append(x[0, 0, c - r:c + r + 1, c - r:c + r + 1].flip(-2, -1))
    return torch.stack(out)


def _normalized(v):
    return v / (torch.linalg.vector_norm(v) + _EPS)


def discriminator(params: dict, state: dict, x: torch.Tensor, q) -> tuple:
    """(score map [B, 1, h, w], new state), BatchNorm in training mode."""
    new = {"u": [], "bn_mean": [], "bn_var": []}

    def conv(i, h, pad):
        w, b, u = params["convs"][i]["w"], params["convs"][i]["b"], state["u"][i]
        wm = q(w.reshape(w.shape[0], -1))
        u1 = _normalized(wm @ _normalized(wm.T @ u))
        sigma = u1 @ (wm @ _normalized(wm.T @ u1))
        new["u"].append(u1.detach())
        return F.conv2d(q(h), q(w / (sigma + _EPS)), b, padding=pad)

    h = F.leaky_relu(conv(0, x, params["convs"][0]["w"].shape[-1] // 2), 0.2)
    for i in range(len(params["bn_scale"])):
        h = conv(1 + i, h, 0)
        n = h.shape[0] * h.shape[2] * h.shape[3]
        mean, var = h.mean(dim=(0, 2, 3)), h.var(dim=(0, 2, 3), unbiased=False)
        new["bn_mean"].append((0.9 * state["bn_mean"][i] + 0.1 * mean).detach())
        new["bn_var"].append((0.9 * state["bn_var"][i] + 0.1 * var * n / (n - 1)).detach())
        h = (h - mean[None, :, None, None]) * torch.rsqrt(var + 1e-5)[None, :, None, None]
        h = h * params["bn_scale"][i][None, :, None, None] + params["bn_bias"][i][None, :, None, None]
        h = F.leaky_relu(h, 0.2)
    return conv(1 + len(params["bn_scale"]), h, 0), new


def kernel_regularization(k: torch.Tensor, w: dict) -> torch.Tensor:
    """Mean over bands of the 5-term physicality regulariser of [bands, K, K]."""
    kh, kw = k.shape[-2:]
    sum1 = (k.sum((-2, -1)) - 1) ** 2
    edges = (k[:, 0] ** 2).sum(-1) + (k[:, -1] ** 2).sum(-1) + (k[:, :, 0] ** 2).sum(-1) \
        + (k[:, :, -1] ** 2).sum(-1)
    pos = k.clamp_min(0)
    sparse = torch.sqrt(pos).sum((-2, -1))
    yy, xx = torch.meshgrid(torch.arange(kh, device=k.device), torch.arange(kw, device=k.device),
                            indexing="ij")
    mass = pos + 1e-12
    cy = (yy * mass).sum((-2, -1)) / mass.sum((-2, -1))
    cx = (xx * mass).sum((-2, -1)) / mass.sum((-2, -1))
    cyy, cxx = (kh - 1) / 2, (kw - 1) / 2
    center = (cy - cyy) ** 2 + (cx - cxx) ** 2
    peak = (k.amax((-2, -1)) - k[:, int(cyy), int(cxx)]) ** 2
    return (w["alpha"] * sum1 + w["beta"] * edges + w["gamma"] * sparse + w["delta"] * center
            + w["epsilon"] * peak).mean()


class Adam:
    """Adam preceded by clipping to a global norm, the gradients' norm
    before clipping returned."""

    def __init__(self, params: list, lr: float, b1: float, b2: float, max_norm: float):
        self.lr, self.b1, self.b2, self.max_norm = lr, b1, b2, max_norm
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, params: list, grads: list) -> torch.Tensor:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).to(grads[0].dtype)
        if norm >= self.max_norm:
            grads = [g / norm * self.max_norm for g in grads]
        self.t += 1
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.add_(-self.lr * (mu / (1 - self.b1 ** self.t))
                   / (torch.sqrt(nu / (1 - self.b2 ** self.t)) + 1e-8))
        return norm


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


class Scene:
    """One scene's KernelGAN training: its parameters (copies of those it
    is given), D's state, both optimizers and its generator."""

    def __init__(self, g_layers: list, d_params: dict, d_state: dict, hr_pool, lr_pool,
                 gen: torch.Generator, cfg: dict, sigma: torch.Tensor, tf32: bool = False,
                 dtype: torch.dtype = torch.float32):
        def own(tree):
            return [own(t) for t in tree] if isinstance(tree, list) else \
                {k: own(v) for k, v in tree.items()} if isinstance(tree, dict) else \
                tree.detach().to(dtype, copy=True).requires_grad_(True)

        self.g = own(list(g_layers))
        self.d = own(d_params)
        self.d_state = {k: [t.detach().to(dtype, copy=True) for t in v]
                        for k, v in d_state.items()}
        self.hr, self.lr = hr_pool.to(dtype), lr_pool.to(dtype)
        self.gen, self.cfg, self.sigma, self.dtype = gen, cfg, sigma.to(dtype), dtype
        self.q = _Prec(tf32)
        self.g_opt = Adam(self.g, cfg["lr"], 0.5, 0.999, cfg["grad_clip"])
        self.d_opt = Adam(leaves(self.d), cfg["lr"], 0.5, 0.999, cfg["grad_clip"])

    def step(self) -> dict:
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return self._step()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev

    def _step(self) -> dict:
        cfg, q, b = self.cfg, self.q, self.cfg["batch_size"]
        dev = self.hr.device
        hr_idx = torch.randint(0, self.hr.shape[0], (b,), generator=self.gen, device=dev)
        lr_idx = torch.randint(0, self.lr.shape[0], (b,), generator=self.gen, device=dev)
        hr, real = self.hr[hr_idx], self.lr[lr_idx]
        raw = composed_kernels(self.g, q)
        p = raw.shape[-1] // 2
        blur = F.conv2d(q(F.pad(hr, (p, p, p, p), mode="reflect")), q(raw[:, None]),
                        groups=raw.shape[0])
        n, c, h, w = blur.shape
        f = cfg["factor"]
        fake = blur.reshape(n, c, h // f, f, w // f, f).mean(dim=(3, 5))
        sig = self.sigma[None, :, None, None]
        noise_d = torch.randn(fake.shape, generator=self.gen, device=dev).to(self.dtype)
        noise_g = torch.randn(fake.shape, generator=self.gen, device=dev).to(self.dtype)

        d_leaves = leaves(self.d)
        pr, st = discriminator(self.d, self.d_state, real, q)
        pf, st = discriminator(self.d, st, (fake + noise_d * sig).detach(), q)
        loss_d = 0.5 * ((pr - 1) ** 2).mean() + 0.5 * (pf ** 2).mean()
        d_grads = torch.autograd.grad(loss_d, d_leaves)
        gn_d = self.d_opt.step(d_leaves, d_grads)

        pf, self.d_state = discriminator(self.d, st, fake + noise_g * sig, q)
        adv = 0.5 * ((pf - 1) ** 2).mean()
        with torch.no_grad():
            ks = raw.detach().clamp_min(0)
            s = ks.sum((-2, -1), keepdim=True)
            ks = ks / torch.where(s <= 1e-12, torch.ones_like(s), s)
            reg = kernel_regularization(ks, cfg["reg_weights"])
        total = adv + cfg["raw_sum_reg"] * ((raw.sum((-2, -1)) - 1) ** 2).mean()
        g_grads = torch.autograd.grad(total, self.g)
        gn_g = self.g_opt.step(self.g, g_grads)
        return {"loss_D": loss_d.detach(), "loss_G_adv": adv.detach(), "loss_reg": reg,
                "grad_norm_D": gn_d, "grad_norm_G": gn_g,
                "grads": [g.detach() for g in list(d_grads) + list(g_grads)]}

    def params(self) -> list:
        """D's leaves (sorted keys), then G's layers: the order of `grads`."""
        return [t.detach().clone() for t in leaves(self.d)] + [t.detach().clone() for t in self.g]
