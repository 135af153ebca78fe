"""Sanitizer: NaN discipline as a runtime check (the port of
distributed_raytracer_tpu/utils/sanitize.py).

Masked lanes and dead branches can carry poison through a `where`'s
backward (0 * inf = NaN: sqrt'(0) inside a branch that a single where
masks).  The double-where discipline prevents it by construction; this
module checks it at run time.

  - `checked(fn)` runs fn under a TorchDispatchMode that looks at every
    aten op, those of an autograd backward included, and raises
    FloatSanitizerError, naming the op, when an op makes a NaN from
    inputs that hold none, or an integer op divides by zero: JAX's
    checkify.float_checks ({NaNError, DivisionByZeroError}).  An inf is
    not an error (a miss carries t = inf).  Ops that return uninitialized
    memory (empty, empty_like, new_empty, empty_strided, resize_, ...) are
    not checked: their bits are whatever the allocator held.
  - `nan_debug()` is a scoped mode that raises FloatingPointError when any
    op's floating output holds a NaN, as jax_debug_nans does.
  - `preflight(scene, camera)` is the forward and the scene gradient of a
    small strided ray batch under `checked`; `render --sanitize` runs it
    before the render, then renders under `nan_debug()`.

Every check reads its tensors back to the host, so a checked op waits for
the card: the sanitizer is for a pre-flight and for debugging runs.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from distributed_raytracer_tpu_torch.core import prng
from distributed_raytracer_tpu_torch.core.device import resolve_device

# the integer ops that divide: a zero divisor is checkify's DivisionByZeroError
_DIVIDING = {"div", "div_", "floor_divide", "floor_divide_", "remainder", "remainder_",
             "fmod", "fmod_"}


class FloatSanitizerError(AssertionError):
    """An op made a NaN from NaN-free inputs, or an integer op divided by
    zero, under `checked`."""


def _uninitialized(func) -> bool:
    """Ops whose output is uninitialized memory."""
    name = func.overloadpacket.__name__
    return "empty" in name or name in ("resize_", "resize_as_")


def _floats(tree):
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _has_nan(tensors) -> bool:
    return any(bool(torch.isnan(t).any()) for t in tensors if t.numel())


class _FloatChecks(TorchDispatchMode):
    """checked's mode: NaN made from NaN-free inputs, integer division by
    zero."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _uninitialized(func):
            return func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _DIVIDING and len(args) >= 2:
            a, b = args[0], args[1]
            a_int = isinstance(a, torch.Tensor) and not (a.is_floating_point()
                                                         or a.is_complex())
            b_int = (isinstance(b, torch.Tensor) and not (b.is_floating_point()
                                                          or b.is_complex())
                     ) or isinstance(b, int)
            if a_int and b_int and bool((torch.as_tensor(b) == 0).any()):
                raise FloatSanitizerError(f"division by zero in {func}")
        clean = not _has_nan(_floats((args, kwargs)))
        out = func(*args, **kwargs)
        if clean and _has_nan(_floats(out)):
            raise FloatSanitizerError(f"nan generated by {func}")
        return out


class _NanDebug(TorchDispatchMode):
    """nan_debug's mode: any NaN in a floating output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _uninitialized(func) and _has_nan(_floats(out)):
            raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


def checked(fn: Callable) -> Callable:
    """fn, run under the float checks: any aten op inside that makes a NaN
    from NaN-free inputs (masked or dead branches included, and the ops of
    a backward that fn runs), or divides integers by zero, raises
    FloatSanitizerError with the op's name.  Returns fn's value."""

    def wrapped(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def nan_debug():
    """Scoped: every aten op whose floating output holds a NaN raises
    FloatingPointError."""
    with _NanDebug():
        yield


def preflight(scene, camera, seed: int = 0, n_rays: int = 256, max_depth: int = 8,
              device=None) -> None:
    """The forward and the gradient with respect to scene.diff_params() of
    n_rays camera rays strided over the image (threefry draws of
    PRNGKey(seed)), traced by ops/trace.py's trace_rays to min(max_depth,
    camera.max_depth), both under checked: raises FloatSanitizerError if
    any op makes poison.  Runs on the card unless device says otherwise."""
    from distributed_raytracer_tpu_torch.ops.camera import generate_rays
    from distributed_raytracer_tpu_torch.ops.trace import trace_rays

    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    key = prng.PRNGKey(seed)
    n_pix = camera.num_pixels
    ids = (torch.arange(n_rays, device=dev) * max(1, n_pix // n_rays)) % n_pix
    w = camera.image_width
    o, d = generate_rays(camera, ids % w, ids // w, key=key)
    depth = min(max_depth, camera.max_depth)

    def fwd(params):
        return trace_rays(scene.with_diff_params(params), o, d, key, depth).sum()

    def grad(params):
        params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        return torch.autograd.grad(fwd(params), list(params.values()))

    with torch.no_grad():
        checked(fwd)(scene.diff_params())  # forward ops
    checked(grad)(scene.diff_params())     # forward and backward ops
