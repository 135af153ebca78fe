"""The port's sanitizer (utils/sanitize.py) on the cases of the JAX
package's tests/test_sanitize.py, on the CPU: the seeded single-where
regression raises at its op, the double-where fix passes, values pass
through, nan_debug is scoped, the pre-flight is clean on config2 and
config4, and `render --sanitize --cpu` runs clean.  The seeded
regression also runs through the JAX package's own check, which flags it
too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.utils import sanitize as jsan
from distributed_raytracer_tpu_torch import cli
from distributed_raytracer_tpu_torch.models import presets
from distributed_raytracer_tpu_torch.render.image import read_ppm
from distributed_raytracer_tpu_torch.utils.sanitize import (
    FloatSanitizerError,
    checked,
    nan_debug,
    preflight,
)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grad(f):
    def g(x):
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(f(x), x)[0]
    return g


def single_where_norm(x):
    # the broken guard: sqrt of the raw value, masked after
    n = torch.sqrt((x * x).sum(-1))
    return torch.where(n > 0, n, 0.0).sum()


def double_where_norm(x):
    s = (x * x).sum(-1)
    safe = torch.where(s > 0, s, 1.0)  # guard before the sqrt
    return torch.where(s > 0, torch.sqrt(safe), 0.0).sum()


def test_seeded_single_where_regression_caught():
    x = torch.zeros(4, 3)
    assert float(checked(single_where_norm)(x)) == 0.0  # the forward alone is clean
    with pytest.raises(FloatSanitizerError, match="nan generated by aten"):
        checked(_grad(single_where_norm))(x)
    # JAX flags the same gradient
    with pytest.raises(jsan.FloatSanitizerError):
        jsan.checked(jax.grad(lambda v: jnp.sum(jnp.where(
            jnp.sqrt(jnp.sum(v * v, -1)) > 0, jnp.sqrt(jnp.sum(v * v, -1)), 0.0))))(
                jnp.zeros((4, 3), jnp.float32))


def test_double_where_fix_passes():
    x = torch.zeros(4, 3)
    g = checked(_grad(double_where_norm))(x)
    assert torch.equal(g, torch.zeros(4, 3))


def test_checked_passes_values_through():
    out = checked(lambda a, b: a * b + 1.0)(torch.tensor(3.0), torch.tensor(4.0))
    assert float(out) == 13.0


def test_inf_passes_and_integer_division_by_zero_raises():
    """An inf is no error (a miss carries t = inf; checkify's float checks
    are NaN and division by zero); a NaN handed in is not made here; an
    integer divide by zero raises."""
    assert float(checked(lambda a: a / 0.0)(torch.tensor(1.0))) == float("inf")
    assert bool(torch.isnan(checked(lambda a: a + 1.0)(torch.tensor(float("nan")))))
    with pytest.raises(FloatSanitizerError, match="division by zero"):
        checked(lambda a: a // torch.tensor([1, 0]))(torch.tensor([3, 4]))
    with pytest.raises(FloatSanitizerError, match="division by zero"):
        checked(lambda a: torch.remainder(a, 0))(torch.tensor([3, 4]))
    # uninitialized memory is not judged
    assert checked(lambda: torch.empty(1 << 16).fill_(1.0).sum())() == 1 << 16


def test_nan_debug_scoped():
    with nan_debug():
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0))
        assert float(torch.log(torch.tensor(1.0))) == 0.0
    assert bool(torch.isnan(torch.log(torch.tensor(-1.0))))


def test_preflight_clean_config2():
    scene, cam = presets.config2()
    preflight(scene, cam, seed=0, n_rays=128, device="cpu")


def test_preflight_clean_config4():
    scene, cam = presets.config4()
    preflight(scene, cam, seed=1, n_rays=128, max_depth=6, device="cpu")


def test_cli_sanitize_smoke(tmp_path):
    out = str(tmp_path / "s.ppm")
    cli.main(["render", "--config", "config1", "--spp", "1", "--width", "32", "--sanitize",
              "--cpu", "--out", out])
    img = read_ppm(out)
    assert img.shape == (18, 32, 3) and np.isfinite(img).all() and img.mean() > 0


def test_preflight_defaults_to_the_card(monkeypatch):
    """device=None means the card: without one the pre-flight refuses to
    run rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, cam = presets.config1()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preflight(scene, cam, n_rays=8)
