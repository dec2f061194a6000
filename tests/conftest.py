"""Test harness config: JAX on the CPU backend with 8 virtual devices, so the
multi-device sharding paths run everywhere (SURVEY §4: multi-host tests via
xla_force_host_platform_device_count).

Tests marked ``gpu`` need a card: they take the ``gpu_env`` fixture, which
skips them when JAX in a child process sees no GPU."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import subprocess  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# never let tests silently use a developer's running scoring server
os.environ.setdefault("MIA_SERVER", "0")

import pytest  # noqa: E402

FIXTURES = os.path.join(REPO, "tests", "fixtures")
GOLDEN = os.path.join(REPO, "tests", "golden")


@pytest.fixture
def fixtures_dir() -> str:
    return FIXTURES


@pytest.fixture
def golden_dir() -> str:
    return GOLDEN


@pytest.fixture(scope="session")
def gpu_env() -> dict:
    """Environment for a child process on the GPU (JAX's default platform,
    no virtual CPU devices).  Skips the test when JAX finds no GPU there."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    r = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    platform = r.stdout.strip().splitlines()[-1] if r.returncode == 0 else ""
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default platform is {platform or 'none'}")
    return env
