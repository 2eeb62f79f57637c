"""Host-side kernel monitoring, training-log analysis and figures (numpy,
matplotlib at first use), and the known-kernel deconvolution oracle
(`analysis.oracle`, plain PyTorch on the device)."""
from .kernel_metrics import ascii_kernel, kernel_delta_l2, kernel_metrics
from .visualize import (
    patch_to_rgb,
    plot_denoise_comparison,
    plot_hr_vs_degraded,
    plot_kernels,
    plot_moe_bank,
    plot_patch_rgb,
    plot_train_sample,
)
from .log_analyzer import analyze_stability, load_training_log
