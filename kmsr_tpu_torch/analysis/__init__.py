"""Host-side kernel monitoring and training-log analysis (numpy), and the
denoise figure."""
from .kernel_metrics import ascii_kernel, kernel_delta_l2, kernel_metrics
from .visualize import plot_denoise_comparison
from .log_analyzer import analyze_stability, load_training_log
