import os

# Honour an explicit JAX_PLATFORMS from the environment for CLI runs, even
# when jax was imported (and its config latched) before this module ran.
# Done here, not in tracs_tpu/__init__, so embedding programs (e.g. the test
# conftest) that set the config themselves are never second-guessed.
_env_platforms = os.environ.get("JAX_PLATFORMS")
if _env_platforms:
    import jax

    try:
        _p = _env_platforms
        if "cpu" not in _p.split(","):
            _p = _p + ",cpu"
        if _p != jax.config.jax_platforms:
            jax.config.update("jax_platforms", _p)
    except Exception:  # pragma: no cover - backends already initialised
        pass

from tracs_tpu.cli import main  # noqa: E402

if __name__ == "__main__":
    main()
