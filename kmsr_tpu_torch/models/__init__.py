"""KernelGAN models: the multi-band linear generator and the
spectral-norm patch discriminator, as functions on dicts of tensors."""
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
