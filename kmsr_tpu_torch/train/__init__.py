"""Trainers: single-kernel KernelGAN, its per-scene fleet (`train.fleet`),
the MoE kernel bank (`train.moe`),
the dynamic degradation model (`train.dynamic`) and their shared state /
optimizer / checkpoint plumbing."""
from .state import (
    GANTrainState,
    make_gan_optimizers,
    init_gan_state,
    save_checkpoint,
    restore_checkpoint,
    latest_checkpoint_step,
)
from .single_kernel import (
    SingleKernelConfig,
    make_base_step,
    make_train_step,
    init_training,
    train_single_kernel,
    random_crops,
)
from .fleet import train_fleet
