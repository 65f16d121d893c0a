"""The work model of the test-only family ``flux_cond``: FLUX.1's step (the
conditioning plane adds no work to it)."""

from benchmark.work.flux import step  # noqa: F401
