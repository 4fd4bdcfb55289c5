"""Optional-dependency shims for the test suite.

``hypothesis`` is an optional (dev-extra) dependency: the property tests use
it when present, but its absence must not break collection of the modules
that also hold plain unit tests.  Import the trio through here instead of
from ``hypothesis`` directly::

    from repro_torch.testing import given, settings, strategies as st

When hypothesis is installed these are the real objects.  When it is not,
``given`` turns each property test into an explicit skip (visible in the
report as "hypothesis not installed"), ``settings`` is a no-op decorator,
and ``strategies`` hands back inert placeholders so decorator arguments
still evaluate at collection time.
"""
from __future__ import annotations

try:
    from hypothesis import given, settings, strategies  # noqa: F401

    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

    import pytest

    class _Strategy:
        def __init__(self, name: str):
            self._name = name

        def __repr__(self) -> str:  # keeps decorator reprs readable
            return f"<{self._name} (hypothesis unavailable)>"

    class _Strategies:
        def __getattr__(self, name: str):
            def _make(*args, **kwargs):
                return _Strategy(f"st.{name}")

            return _make

    strategies = _Strategies()

    def settings(*args, **kwargs):
        def deco(fn):
            return fn

        return deco

    def given(*args, **kwargs):
        def deco(fn):
            # A plain zero-arg function: pytest must not see the wrapped
            # test's parameters (it would demand fixtures for them).
            def skipper():
                pytest.skip("hypothesis not installed "
                            "(pip install -e '.[dev]')")

            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            return skipper

        return deco
