"""Driver contract tests: entry() compiles, dryrun_multichip(8) executes."""

import importlib.util
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_graft():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(REPO, "__graft_entry__.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_compiles_and_runs():
    import jax

    mod = load_graft()
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (256, 3)
    assert np.all(np.isfinite(np.asarray(out)))


def test_dryrun_multichip_8():
    mod = load_graft()
    mod.dryrun_multichip(8)


def test_dryrun_multichip_hermetic_subprocess():
    """Regression: the multi-device dry run must not depend on the caller's
    environment.

    The driver calls dryrun_multichip in an environment with NO
    JAX_PLATFORMS / XLA_FLAGS presets and possibly an accelerator plugin
    installed; the function must force the CPU platform and device count
    itself.  Run it in a subprocess with both vars stripped.
    """
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [
            sys.executable,
            "-c",
            "import __graft_entry__; __graft_entry__.dryrun_multichip(8); "
            "import jax; assert jax.default_backend() == 'cpu'",
        ],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip(8) OK" in proc.stdout


def test_entry_grid_densities_are_live():
    """The exported render fn must actually cull from its grid-densities
    argument: a dead grid renders pure background, an occupied one does
    not (regression: a step-0 grid state tests all-occupied during warmup
    regardless of densities)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__

    fn, (params, densities, key, rays) = __graft_entry__.entry()
    live = jax.jit(fn)(params, densities, key, rays)
    dead = jax.jit(fn)(params, jnp.zeros_like(densities), key, rays)
    # Background is zeros; the dead grid must composite exactly to it.
    np.testing.assert_allclose(np.asarray(dead), 0.0, atol=1e-6)
    assert float(jnp.abs(live).max()) > 1e-3
