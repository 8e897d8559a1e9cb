# NOTE: no XLA_FLAGS here on purpose — tests must see the host's real
# single CPU device. Only launch/dryrun.py (never imported by tests)
# forces the 512-device count.
import functools
import inspect
import sys
import types

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# hypothesis fallback: on a bare environment the 6 property-test modules must
# still collect and run. The shim replays a fixed number of seeded examples
# through the same @settings/@given decorator surface the tests already use.
# Install the real package (requirements.txt) to get shrinking + the database.

try:
    import hypothesis  # noqa: F401
except ImportError:
    def _make_strategies():
        st = types.ModuleType("hypothesis.strategies")

        def integers(min_value, max_value):
            return lambda rng: int(rng.integers(min_value, max_value + 1))

        def floats(min_value, max_value):
            return lambda rng: float(rng.uniform(min_value, max_value))

        def sampled_from(elements):
            elements = list(elements)
            return lambda rng: elements[int(rng.integers(len(elements)))]

        def booleans():
            return lambda rng: bool(rng.integers(2))

        st.integers, st.floats = integers, floats
        st.sampled_from, st.booleans = sampled_from, booleans
        return st

    def _given(**strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                rng = np.random.default_rng(0)
                for _ in range(getattr(wrapper, "_max_examples", 10)):
                    drawn = {k: draw(rng) for k, draw in strategies.items()}
                    fn(*args, **drawn, **kwargs)

            # hide the strategy-supplied params so pytest doesn't treat
            # them as fixtures (what real hypothesis does)
            sig = inspect.signature(fn)
            wrapper.__signature__ = sig.replace(parameters=[
                p for name, p in sig.parameters.items()
                if name not in strategies])
            return wrapper
        return deco

    def _settings(**kwargs):
        def deco(fn):
            fn._max_examples = kwargs.get("max_examples", 10)
            return fn
        return deco

    _hyp = types.ModuleType("hypothesis")
    _hyp.given, _hyp.settings = _given, _settings
    _hyp.strategies = _make_strategies()
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _hyp.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "chaos: seeded fault-injection runs over full pipelined jobs "
        "(deterministic; gated in test.sh/CI alongside bench_chaos.py)")
    config.addinivalue_line(
        "markers",
        "outofcore: streamed out-of-core FFT runs over a real on-disk "
        "BlockStore (small sizes; the big gate is bench_outofcore.py)")
    config.addinivalue_line(
        "markers",
        "serve: FFT-as-a-service front-end tests (admission control, "
        "dynamic batching, deadlines; the load gate is bench_serve.py)")
    config.addinivalue_line(
        "markers",
        "verify: ABFT silent-corruption defense tests (invariant checks, "
        "corrupt fault rules, quarantine-and-recompute; the storm gate "
        "is bench_verify.py)")
    config.addinivalue_line(
        "markers",
        "tune: measuring-autotuner and persistent-wisdom tests "
        "(determinism, wisdom round-trips, corrupt-file degradation; "
        "the measured-vs-analytic gate is bench_tune.py)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's kernels have no CPU mode); "
        "skips without one, decided inside the test's fixture")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
