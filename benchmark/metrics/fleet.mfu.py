"""The fleet's share of the card's float32 peak outside the tensor cores
(the configuration trains in float32 with TF32 off): one scene-iteration's
FLOPs (`counts.kernelgan_flops_per_scene_it`) times the scene-iterations of
the traced window, over its seconds."""
import counts


def read(run):
    t = run.trace_summary
    if t is None or run.peaks is None or not run.counts.get("traced_scene_its") or not t["window_s"]:
        return None
    flops = counts.kernelgan_flops_per_scene_it(run.config["train_kernel"])
    return 100 * flops * run.counts["traced_scene_its"] / t["window_s"] / run.peaks["fp32"]
