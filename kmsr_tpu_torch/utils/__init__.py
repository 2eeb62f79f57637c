"""Host utilities: profiling, `.npz` model files (`params_io`), the
reference's torch checkpoints (`torch_import`) and pytrees of tensors
(`tree`)."""
