"""Process settings the test modules share: JAX's x64 switch reset between
modules, and one torch thread a worker.

jwas_tpu's runMCMC(double_precision=True) turns JAX's x64 mode on for the
whole process and leaves it on (ROADMAP.md fault R8); a float32 test that
pytest-xdist later runs in the same worker then fails. This module
registers itself as a pytest plugin (every worker collects every test
file, and pytest reads pytest_plugins from test modules), and its
pytest_runtest_setup hook puts jax_enable_x64 back to its value at the
start of the session whenever the next test comes from another module. No
test module turns x64 on when it is imported, so a module starts as the
session did.

The port's CPU tests multiply small tensors, as fast on one thread as on
all of them; under pytest-xdist each worker's torch would start a thread a
core, and the workers together would hold several times more threads than
cores. Every worker imports this module, so each runs torch on one thread.
"""

import os
import subprocess
import sys
import textwrap

import torch

pytest_plugins = (__name__,)
torch.set_num_threads(1)


def _x64_at_start():
    """x64 as the session starts: JAX's setting when it is already
    imported (tests/conftest.py imports it), else its environment default."""
    jax = sys.modules.get("jax")
    if jax is not None:
        return bool(jax.config.jax_enable_x64)
    return os.environ.get("JAX_ENABLE_X64", "").lower() in ("1", "true")


_X64_AT_START = _x64_at_start()
_last_module = [None]


def pytest_runtest_setup(item):
    module = getattr(item, "path", None)
    if module == _last_module[0]:
        return
    _last_module[0] = module
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update("jax_enable_x64", _X64_AT_START)


FILES = {
    "test_a_turns_x64_on.py": """
        import jax

        def test_on():
            jax.config.update("jax_enable_x64", True)
            assert jax.config.jax_enable_x64
        """,
    "test_b_expects_x64_off.py": """
        import jax
        import jax.numpy as jnp

        def test_off():
            assert not jax.config.jax_enable_x64
            assert jnp.asarray(1.0).dtype == jnp.float32
        """,
}
# registers this module's hook the way this module registers itself
PLUGIN = """
    import sys
    sys.path.insert(0, {tests!r})
    from test_torch_isolation import pytest_runtest_setup  # noqa: F401
    pytest_plugins = (__name__,)
    """


def _run(folder, names, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTEST_XDIST_WORKER", None)
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", *args, *names],
        cwd=folder, env=env, capture_output=True, text=True, timeout=300)


def test_x64_is_reset_between_modules(tmp_path):
    """A module that turns x64 on, then one that needs it off: without the
    hook the second fails; with the registering module collected first,
    between them or last, it passes, also under xdist with --dist loadfile."""
    for name, body in FILES.items():
        (tmp_path / name).write_text(textwrap.dedent(body))
    (tmp_path / "test_z_plugin.py").write_text(textwrap.dedent(
        PLUGIN.format(tests=os.path.dirname(os.path.abspath(__file__)))))
    for name in ("test_0_plugin.py", "test_ab_plugin.py"):
        (tmp_path / name).write_text((tmp_path / "test_z_plugin.py").read_text())
    pair = list(FILES)
    bare = _run(tmp_path, pair)
    assert bare.returncode == 1 and "1 failed, 1 passed" in bare.stdout, bare.stdout
    for order in (["test_0_plugin.py", *pair], [pair[0], "test_ab_plugin.py", pair[1]],
                  [*pair, "test_z_plugin.py"]):
        out = _run(tmp_path, order)
        assert out.returncode == 0 and "2 passed" in out.stdout, (order, out.stdout)
    out = _run(tmp_path, [*pair, "test_z_plugin.py"], "-p", "xdist", "-n", "2",
               "--dist", "loadfile")
    assert out.returncode == 0 and "2 passed" in out.stdout, out.stdout
