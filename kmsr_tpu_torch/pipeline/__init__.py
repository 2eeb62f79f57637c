"""Pipeline stage runners (file-in/file-out contracts): the fused factory
and its two-stage equivalent, apply_kernel -> make_train_data; the
whole-scene degrade, degrade_scene; the stage CLIs of the DAG, and
run_all, which sequences them from one config; inspect_nc and data_stats,
the validation tools beside check_shapes."""
from .common import RunReport, run_per_file
