"""Import the reference's trained torch checkpoints.

Counterpart of `kmsr_tpu.utils.torch_import`. The reference ships
`moe_kernels/moe_model.pth`, a torch state_dict of its content-adaptive
degradation model (selector CNN + kernel/sigma banks). This module maps it
onto `models.moe` parameters. Key layout of the reference checkpoint:

  kernel_bank [K,C,13,13], sigma_bank [K,C]  — raw banks (softmax/softplus
    are applied at use time)
  selector.features.{0,3,6}.{weight,bias}    — stride-2 convs (OIHW)
  selector.features.{1,4,7}.*                — BatchNorm2d affine + running
  selector.classifier.{weight,bias}          — final Linear -> K logits

Both use cross-correlation convs with padding 1 / stride 2, so the weights
transfer without flipping or transposition.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.moe import MoEConfig


def load_moe_torch_checkpoint(
    path: str, cfg: MoEConfig | None = MoEConfig(),
    device: str | torch.device = "cuda",
) -> tuple[dict, dict]:
    """A reference `moe_model.pth` as (params, state) for
    `models.moe.moe_forward`, float32 on `device`.

    cfg=None infers (n_kernels, n_channels) from the checkpoint's bank
    instead of checking them against an expected config."""
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)

    def arr(key):
        return sd[key].detach().to(dev, torch.float32)

    convs, bn_scale, bn_bias, bn_mean, bn_var = [], [], [], [], []
    for conv_i, bn_i in ((0, 1), (3, 4), (6, 7)):
        convs.append({"w": arr(f"selector.features.{conv_i}.weight"),
                      "b": arr(f"selector.features.{conv_i}.bias")})
        bn_scale.append(arr(f"selector.features.{bn_i}.weight"))
        bn_bias.append(arr(f"selector.features.{bn_i}.bias"))
        bn_mean.append(arr(f"selector.features.{bn_i}.running_mean"))
        bn_var.append(arr(f"selector.features.{bn_i}.running_var"))

    params = {
        "selector": {
            "convs": convs,
            "bn_scale": bn_scale,
            "bn_bias": bn_bias,
            "fc_w": arr("selector.classifier.weight"),
            "fc_b": arr("selector.classifier.bias"),
        },
        "kernel_bank": arr("kernel_bank"),
        "sigma_bank": arr("sigma_bank"),
    }
    state = {"selector": {"bn_mean": bn_mean, "bn_var": bn_var}}

    k, c = params["kernel_bank"].shape[:2]
    if cfg is not None and (k, c) != (cfg.n_kernels, cfg.n_channels):
        raise ValueError(
            f"checkpoint banks are [{k},{c}], config expects "
            f"[{cfg.n_kernels},{cfg.n_channels}]"
        )
    return params, state
