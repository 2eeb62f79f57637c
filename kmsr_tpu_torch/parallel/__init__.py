"""Row-slab scene parallelism (`spatial`). The mesh, GAN sharding and
multi-host helpers of `kmsr_tpu.parallel` come with their slice
(ROADMAP.md, module queue item 9)."""
