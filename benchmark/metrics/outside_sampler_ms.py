"""outside_sampler_ms (ms per image; layer: pipeline; moves s_per_image):
each image's wall time minus the time inside its ``ksample`` calls (timed
with a device synchronisation on each side in the traced run): the text
encoders, the hires-fix upscale, the decode, AutoHDR and the PNG."""

LAYER = "pipeline"


def read(run):
    timed = [i for i in run.images if i["sampler_s"] > 0]
    if not timed:
        return None
    return 1e3 * sum(i["end"] - i["start"] - i["sampler_s"] for i in timed) / len(timed)
