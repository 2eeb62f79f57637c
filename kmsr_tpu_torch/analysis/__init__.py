"""Host-side kernel monitoring (numpy)."""
from .kernel_metrics import ascii_kernel, kernel_delta_l2, kernel_metrics
