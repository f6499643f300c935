"""device_idle (%; layer: device; moves s_per_image): 1 - (the union of the
device's kernel intervals, from ``torch.profiler`` over the traced window)
/ (the window's wall time). The profiler and the traced run's
synchronisations slow the host, so this reads above an untraced run's."""

LAYER = "device"


def read(run):
    busy, window = run.device.get("busy_s"), run.device.get("window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
