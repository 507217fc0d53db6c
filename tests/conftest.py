import os
import sys

# smoke tests and benches must see 1 device — dryrun.py (and only dryrun.py)
# forces 512. Make sure a stray env doesn't leak in.
os.environ.pop("XLA_FORCE_HOST_PLATFORM_DEVICE_COUNT", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))  # for _hypothesis_compat


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")
