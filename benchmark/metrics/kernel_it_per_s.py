"""KernelGAN iterations summed over the fleet's scenes, over the window's
seconds, the window ended by a synchronize."""


def read(run):
    if "scene_its" not in run.counts or not run.window_s:
        return None
    return run.counts["scene_its"] / run.window_s
