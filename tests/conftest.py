"""Test-session bootstrap.

1. Puts ``src/`` on ``sys.path`` so ``python -m pytest`` works without the
   ``PYTHONPATH=src`` prefix.
2. Installs a minimal ``hypothesis`` fallback when the real package is not
   available (it is an optional dev dependency; see requirements-dev.txt).
   The shim supports exactly the surface the test suite uses — ``given``
   (keyword strategies), ``settings(max_examples=, deadline=)``,
   ``strategies.integers`` and ``strategies.composite`` — running each
   property test over a deterministic sample of drawn inputs. With real
   hypothesis installed (as in CI) the shim is inert.
"""
from __future__ import annotations

import functools
import os
import sys
import types
import zlib

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def _install_hypothesis_shim() -> None:
    import numpy as np

    class _Strategy:
        def __init__(self, draw_fn):
            self._draw = draw_fn

    def integers(min_value=None, max_value=None):
        lo = 0 if min_value is None else int(min_value)
        hi = 2**31 - 1 if max_value is None else int(max_value)
        return _Strategy(lambda rng: int(rng.integers(lo, hi + 1)))

    def composite(fn):
        @functools.wraps(fn)
        def builder(*args, **kwargs):
            def draw_fn(rng):
                return fn(lambda s: s._draw(rng), *args, **kwargs)
            return _Strategy(draw_fn)
        return builder

    def settings(max_examples: int = 10, deadline=None, **_ignored):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn
        return deco

    def given(**strategy_kw):
        def deco(fn):
            # NOTE: deliberately not functools.wraps — pytest would follow
            # __wrapped__ to the original signature and demand fixtures for
            # the strategy-drawn parameters. The wrapper takes no arguments;
            # every parameter comes from a strategy (the suite's only usage).
            def wrapper():
                n = getattr(wrapper, "_shim_max_examples", 10)
                name_seed = zlib.crc32(fn.__qualname__.encode())
                for i in range(n):
                    rng = np.random.default_rng([name_seed, i])
                    drawn = {k: s._draw(rng)
                             for k, s in strategy_kw.items()}
                    try:
                        fn(**drawn)
                    except _ShimAssumption:
                        continue        # failed assume(): skip this example
            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper
        return deco

    class _ShimAssumption(Exception):
        pass

    def assume(condition) -> bool:
        # The shim cannot resample; a failed assumption skips the current
        # example (caught in the given() wrapper).
        if not condition:
            raise _ShimAssumption()
        return True

    mod = types.ModuleType("hypothesis")
    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.integers = integers
    st_mod.composite = composite
    mod.strategies = st_mod
    mod.given = given
    mod.settings = settings
    mod.assume = assume
    mod.__version__ = "0.0-shim"
    mod.__is_shim__ = True
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st_mod


try:
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_shim()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit; skips "
                   "where torch.cuda.is_available() is false")
