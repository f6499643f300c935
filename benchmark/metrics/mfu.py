"""mfu (%; layer: models; moves s_per_image): the least time the model
work of the traced window's profiled images (all but the first) could take
at the H100's published dense peaks, over those images' wall time. The
work is counted by ``benchmark/flops/<kind>.py`` from the shapes of every
model call (the UNet or DiT, the VAE decode, the text encoders), each
class at the peak of the precision the configuration states for it
(``benchmark.peaks``)."""

from benchmark import manifest, peaks

LAYER = "models"


def read(run):
    if not run.model_calls or run.profiled_s <= 0:
        return None
    counters, least = {}, 0.0
    for kind, section, info in run.model_calls:
        if kind not in counters:
            counters[kind] = manifest.load_module("flops", kind, run.bench_dir)
        for cls, ops in counters[kind].count(run.config[section], info).items():
            least += ops / peaks.FLOPS[cls]
    return 100.0 * least / run.profiled_s
