"""Host utilities: profiling, `.npz` model files (`params_io`) and the
reference's torch checkpoints (`torch_import`)."""
