"""Trainers: single-kernel KernelGAN and its state / optimizer /
checkpoint plumbing."""
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
