"""Host-side kernel monitoring (numpy) and the denoise figure."""
from .kernel_metrics import ascii_kernel, kernel_delta_l2, kernel_metrics
from .visualize import plot_denoise_comparison
