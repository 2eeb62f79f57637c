"""The degradation models and the discriminator, as functions on dicts of
tensors: KernelGAN's multi-band linear generator, the spectral-norm patch
discriminator, the MoE kernel bank (`models.moe`) and the content-
conditioned dynamic generator (`models.dynamic`)."""
from .generator import (
    GeneratorConfig,
    init_generator,
    generator_forward,
    extract_kernels,
    extract_merged_kernel,
    gaussian_kernel,
)
from .discriminator import (
    DiscriminatorConfig,
    init_discriminator,
    discriminator_forward,
)
