"""The hand-written kernels have no backward, and say so.

Neither package has a backward for any of its kernels: the JAX package
defines no ``custom_vjp``, and ``jax.grad`` through its Pallas kernels
fails. Here a wrapper launches its kernel through ctypes into a buffer it
allocated, which autograd does not see: on the card the result would carry
no ``grad_fn``, and a loss through it would train with a zero gradient into
the kernel's inputs and raise nothing.

So each wrapper is decorated with ``no_backward(<kernel>)``. When grad
mode is on and one of its arguments requires grad, the call becomes a
``torch.autograd.Function`` whose forward is the wrapper's call as before
(grad mode is off inside it) and whose backward raises ``NoBackwardError``
naming the kernel. The check comes before the wrapper's body, and so before
its CPU branch: the plain versions the CPU takes refuse the backward too.
A call with grad mode off, or with no argument that requires grad, runs the
wrapper's body as before, after one look at each argument.

The body also runs in the span ``kernels.<wrapper's name>``
(``utils.profiling.kernel_span``): the wrapper's host work, recorded when
spans are on. The decorated function stays the outermost one, so the
module global keeps its launch counters.
"""

from __future__ import annotations

import functools

import torch

from lightdiffusion_next_tpu_torch.utils import profiling


class NoBackwardError(RuntimeError):
    """A backward reached a hand-written kernel."""


def message(kernel: str) -> str:
    return (f"{kernel} has no backward: neither this port nor the JAX package has a "
            "backward for its hand-written kernels. Differentiate through the plain ops: "
            "dense weights and RuntimeConfig(attention_backend=\"sdpa\"), as "
            "parallel.trainer does.")


class _NoBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, fn, *inputs):
        ctx.kernel = kernel
        return fn()

    @staticmethod
    def backward(ctx, *grads):
        raise NoBackwardError(message(ctx.kernel))


def no_backward(kernel: str):
    """Decorate a kernel's wrapper: a call under grad mode with an argument
    that requires grad becomes a node of the graph whose backward raises
    ``NoBackwardError`` for ``kernel``; every call is the span
    ``kernels.<wrapper's name>``."""

    def wrap(fn):
        fn = profiling.kernel_span(f"kernels.{fn.__name__}")(fn)

        @functools.wraps(fn)
        def guarded(*args, **kw):
            if torch.is_grad_enabled():
                inputs = [a for a in (*args, *kw.values())
                          if isinstance(a, torch.Tensor) and a.requires_grad]
                if inputs:
                    return _NoBackward.apply(kernel, functools.partial(fn, *args, **kw), *inputs)
            return fn(*args, **kw)

        return guarded

    return wrap
