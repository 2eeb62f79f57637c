"""kmsr_tpu_torch — the PyTorch + CUDA port of `kmsr_tpu`, for NVIDIA Hopper.

The JAX package `kmsr_tpu` is the reference; this package mirrors its
layout and module names so each function's counterpart is easy to find
(`kmsr_tpu.ops.degrade_pallas` -> `kmsr_tpu_torch.ops.degrade_fused`,
`kmsr_tpu.pipeline.factory` -> `kmsr_tpu_torch.pipeline.factory`, ...)
and writes the same artifacts (grouped `.nc` hr/lr files), so a stage run
by either package can feed the other.

Rules the package keeps:

* It imports `torch`, never `jax`, and nothing of `kmsr_tpu` — not even
  its JAX-free host modules (`io/`, `runtime/`): it keeps its own copies.
* Entry points take `device=` (CLI `--device`) and default to "cuda". A
  CUDA request on a host without a card raises (`device.resolve_device`);
  nothing falls back to the CPU silently.
* Every Pallas kernel on a ported path is a hand-written Hopper kernel
  (`kernels/`), with a plain PyTorch version beside it. The plain version
  runs only for tensors that lie on the CPU (the tests); a CUDA tensor
  launches the kernel or raises.

Ported so far: the single-kernel fused train-data factory
(`pipeline.factory`), its `.nc` route (v3 stencil kernel) and its `.npy`
route (halo-free presplit kernel fed by the native split loader); the
whole-scene degrade (`pipeline.degrade_scene` -> `parallel.spatial` ->
`ops.degrade_scene_fast`, the scene stencil kernel over row slabs);
single-kernel KernelGAN training (`pipeline.train_single_kernel_cli` ->
`train.single_kernel` -> `models`, `losses`; plain PyTorch, as the JAX
path is XLA convolutions, no Pallas kernel); the front half of the data
DAG: NLM denoising (`pipeline.denoise_cli` -> `ops.nlm`, `ops.sigma`;
plain PyTorch, as the JAX NLM is an XLA shift sweep), the noise pool
(`pipeline.noise_pool_cli` -> `data.noise_pool`), the patch cutter
(`pipeline.cut` -> `data.patches`, `data.mask`) and the shape gate
(`pipeline.check_shapes`), so every stage of the default single-kernel
DAG runs through the port's own CLIs; and the two other kernel estimators
with their routes: the MoE kernel bank (`pipeline.train_moe_cli` ->
`train.moe` -> `models.moe`; the factory's and apply_kernel's `--moe`
routes; `.npz` model files in the JAX layout, `utils.params_io`, and the
reference's `moe_model.pth`, `utils.torch_import`) and the dynamic
degradation model (`pipeline.train_dynamic_cli` -> `train.dynamic` ->
`models.dynamic`), plain PyTorch as JAX's are XLA.
"""

__version__ = "0.1.0"
