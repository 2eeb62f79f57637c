"""Degradation ops: the plain PyTorch path (`degrade`), the fused Hopper
kernel's entry points (`degrade_fused`) and the whole-scene slab stencil
(`degrade_scene_fast`)."""
