"""Row-slab scene parallelism (`spatial`). The mesh, GAN sharding and
multi-host helpers of `kmsr_tpu.parallel` come with their slice
(ROADMAP.md, queue 1 item 7)."""
