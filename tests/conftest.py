import os
import sys

# Tests must see ONE device (the dry-run alone uses 512 fake devices, via
# subprocess). Distributed tests spawn subprocesses with their own XLA_FLAGS.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

# hypothesis is optional: property tests skip without it (via hypo_compat),
# and the profile is only registered when it is installed.
try:
    from hypothesis import settings
except ModuleNotFoundError:
    pass
else:
    settings.register_profile("repro", max_examples=15, deadline=None)
    settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels have no CPU "
        "mode); skips without one")
