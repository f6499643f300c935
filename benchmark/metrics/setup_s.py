"""setup_s (s, lower, end to end, host clock): from the process's start to
the start of the timed window: imports, the weights drawn on the device,
the program's own set-up (W8A8 requantization, scan stacking, the kernel
libraries loaded from ``build/kernels``) and the warm-up image."""


def read(run):
    return run.setup_s
