"""Pipeline stage runners (file-in/file-out contracts): the fused factory
and its two-stage equivalent, apply_kernel -> make_train_data; and the
whole-scene degrade, degrade_scene."""
from .common import RunReport, run_per_file
