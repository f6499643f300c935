"""sampler_it_per_s (it/s; layer: sampling; moves s_per_image): all sampler
steps of the window over all the time inside ``ksample`` (synchronised, in
the traced run); the hires-fix pass counts its own steps."""

LAYER = "sampling"


def read(run):
    steps = sum(i["steps"] for i in run.images)
    secs = sum(i["sampler_s"] for i in run.images)
    return steps / secs if steps and secs > 0 else None
