"""s_per_image (s, lower, end to end, host clock): the window's wall time
over the images completed in it; one client, the next ``pipeline()`` call
starting when the last returned with its PNG written. All the time over
all the images, so a stall anywhere in the window shows."""


def read(run):
    return run.window_s / len(run.images) if run.images else None
