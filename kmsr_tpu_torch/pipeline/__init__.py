"""Pipeline stage runners (file-in/file-out contracts): the fused factory
and its two-stage equivalent, apply_kernel -> make_train_data."""
from .common import RunReport, run_per_file
