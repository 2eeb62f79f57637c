"""Degradation ops: the plain PyTorch path (`degrade`) and the fused
Hopper kernel's entry points (`degrade_fused`)."""
