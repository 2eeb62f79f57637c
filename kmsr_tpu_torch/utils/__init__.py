"""Host utilities (profiling)."""
